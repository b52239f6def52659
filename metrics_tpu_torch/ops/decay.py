"""Time-semantics operations: exponential decay, pane rotation, CUSUM segment folds.

Counterpart of ``metrics_tpu/ops/decay.py``: plain tensor operations on the
states' device, no kernel. Every state stays mergeable by its declared
algebra.

* **decay**: a sum-algebra state observed at ``last_t`` and brought to a later
  reference time ``ref`` is ``state * 2^(-(ref - last_t)/half_life)``; two
  states brought to a common reference time merge by their own algebra.
* **panes**: a pane is addressed by its absolute number ``floor(t / pane_s)``
  and stored in slot ``pane_id % n_panes``; writes rotate, nothing is spliced.
* **cusum**: the associative, order-sensitive segment summary of CUSUM change
  detection, ``(total, stat, prefix, watermark)`` per side.

The float32 rounding is the JAX package's on its CPU backend, so that decay
weights and pane ids are equal to its own: ``exp2`` is its float32 ``exp`` of
``x * fl(ln 2)`` (Cephes' polynomial with fused multiply-adds, subnormals
flushed), and inside its compiled updates XLA folds constant factors (a
division by a constant becomes a product with its float32 reciprocal). The
functions say which form they reproduce.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from metrics_tpu_torch.utils.checks import device_constant_cache

__all__ = [
    "cusum_compose",
    "cusum_segment",
    "decay_weights",
    "decayed_hll_estimate",
    "pane_id",
    "pane_slot_onehot",
]

# Cephes' polynomial for exp(r), |r| <= ln(2) / 2, as XLA's CPU backend evaluates float32 exp
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_LN2_F32 = float(np.float32(math.log(2.0)))


def _f32(value: float) -> float:
    """``value`` rounded to float32 (as a Python float, exact in float64)."""
    return float(np.float32(value))


def _fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with the product exact (in float64) and one final rounding to float32."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


@device_constant_cache(maxsize=8)
def _poly_f64(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The polynomial's float32 coefficients as float64 tensors on ``device``, made once."""
    # float64 by design: the products of the float32 polynomial are exact
    return tuple(torch.full((), _f32(c), dtype=torch.float64, device=device) for c in _EXP_POLY)  # jitlint: disable=JL004


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` as the JAX package's CPU backend computes it, on ``x``'s device (torch's own ``exp``
    differs from it by an ulp on some inputs). Each fused multiply-add is one float64 operation, exact before
    its rounding to float32: the product of two float32 values fits in a float64."""
    x = torch.clamp(x.to(torch.float32), -104.0, 88.8)
    n = torch.clamp(torch.floor(_fma_f32(x, _f32(1.44269504088896341), 0.5)), -127, 127)
    n64 = n.to(torch.float64)
    r = torch.add(x.to(torch.float64), n64, alpha=-0.693359375).to(torch.float32)
    r = torch.add(r.to(torch.float64), n64, alpha=_f32(2.12194440e-4)).to(torch.float32)
    r64 = r.to(torch.float64)
    poly = _poly_f64(r.device)
    z = torch.add(poly[1], r64, alpha=_f32(_EXP_POLY[0])).to(torch.float32)
    for c in poly[2:]:
        z = torch.addcmul(c, z.to(torch.float64), r64).to(torch.float32)
    z = 1.0 + torch.addcmul(r64, z.to(torch.float64), (r * r).to(torch.float64)).to(torch.float32)
    # 2^n from its bits; n = -127 gives 0, and every such product is below the normal range anyway
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = z * scale
    return torch.where(out < torch.finfo(torch.float32).tiny, torch.zeros_like(out), out)


def _exp2_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp2`` as the JAX package's CPU backend computes it: its ``exp`` of ``x * fl(ln 2)``."""
    return _exp_f32(x.to(torch.float32) * _LN2_F32)


def _as_f32(value, device) -> torch.Tensor:
    """``value`` as a float32 tensor on ``device``: a Python number is filled in place there (no host copy)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.full((), float(value), dtype=torch.float32, device=device)


def _anchor(last_t, t) -> Tuple[torch.Tensor, torch.Tensor]:
    """The common reference time ``max(last_t, t)`` and the two ages ``(ref - last_t, ref - t)``, stacked."""
    device = last_t.device if isinstance(last_t, torch.Tensor) else (t.device if isinstance(t, torch.Tensor) else None)
    t = _as_f32(t, device)
    last_t = _as_f32(last_t, t.device)
    ref = torch.maximum(last_t, t)
    return ref, torch.stack([ref - last_t, ref - t])


def decay_weights(last_t, t, half_life_s: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Common reference time and the two decay factors that bring a state pair to it.

    Returns ``(ref, w_old, w_new)`` with ``ref = max(last_t, t)``,
    ``w_old = 2^(-(ref - last_t)/half_life)`` for the accumulated state and
    ``w_new = 2^(-(ref - t)/half_life)`` for the incoming one. Both exponents
    are >= 0, so the weights lie in [0, 1] and underflow to 0.0, never NaN.
    The bits are those of the JAX package's function called eagerly (its
    ``merge_state`` runs so).
    """
    ref, age = _anchor(last_t, t)
    w_old, w_new = _exp2_f32(-age * _f32(1.0 / float(half_life_s)))
    return ref, w_old, w_new


def _decay_weights_compiled(last_t, t, half_life_s: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`decay_weights` with the bits of the JAX package's compiled updates, where XLA folds
    ``fl(1/half_life) * fl(ln 2)`` into one float32 constant before the ``exp``."""
    ref, age = _anchor(last_t, t)
    w_old, w_new = _exp_f32(-age * _f32(_f32(1.0 / float(half_life_s)) * _LN2_F32))
    return ref, w_old, w_new


def _decay_fold(state: torch.Tensor, w_old: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """``state * w_old + add`` rounded once for a float32 state, as XLA contracts the product and the sum into
    a fused multiply-add in the JAX package's compiled updates (the product is exact in float64); a float64
    state takes two roundings."""
    if state.dtype != torch.float32:
        return state * w_old + add
    return (state.to(torch.float64) * w_old.to(torch.float64) + add.to(torch.float64)).to(torch.float32)


def pane_id(t, pane_s: float) -> torch.Tensor:
    """Absolute pane number of timestamp ``t``: ``floor(t / pane_s)``, () int32.

    The division is a product with ``fl(1 / pane_s)``, as XLA compiles the
    JAX package's updates, so the ids are equal at pane boundaries too.
    """
    t = _as_f32(t, t.device if isinstance(t, torch.Tensor) else None)
    return torch.floor(t * _f32(1.0 / _f32(pane_s))).to(torch.int32)


def pane_slot_onehot(cur_id: torch.Tensor, n_panes: int) -> torch.Tensor:
    """(n_panes,) bool mask selecting the rotating slot ``cur_id % n_panes``."""
    cur_id = torch.as_tensor(cur_id)
    return torch.arange(n_panes, dtype=torch.int32, device=cur_id.device) == torch.remainder(cur_id, n_panes)


def cusum_segment(y: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Fold one batch of deviations into a (4,) float32 CUSUM segment summary ``(T, S, P, M)``.

    ``T`` is the total, ``S`` the CUSUM statistic after the segment started
    from 0 (the largest suffix sum, the empty one included), ``P`` the
    largest prefix sum and ``M`` the watermark, the highest the statistic got
    inside the segment. With prefix sums ``c`` (``c_0 = 0``): ``S = c_n -
    min c``, ``P = max c``, ``M = max(c - cummin c)``. Invalid rows count 0.
    """
    y = torch.as_tensor(y, dtype=torch.float32).reshape(-1)
    y = torch.where(torch.as_tensor(valid, dtype=torch.bool, device=y.device).reshape(-1), y, torch.zeros_like(y))
    c = torch.cat([torch.zeros(1, dtype=torch.float32, device=y.device), torch.cumsum(y, 0)])
    total = c[-1]
    stat = total - torch.min(c)
    prefix = torch.max(c)
    watermark = torch.max(c - torch.cummin(c, 0).values)
    return torch.stack([total, stat, prefix, watermark])


def cusum_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose two (..., 4) segment summaries, ``a`` strictly before ``b`` in stream order.

    Associative, not commutative: ``T = T_a + T_b``, ``S = max(S_b, S_a +
    T_b)``, ``P = max(P_a, T_a + P_b)``, ``M = max(M_a, M_b, S_a + P_b)``.
    """
    ta, sa, pa, ma = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    tb, sb, pb, mb = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [ta + tb, torch.maximum(sb, sa + tb), torch.maximum(pa, ta + pb), torch.maximum(torch.maximum(ma, mb), sa + pb)],
        dim=-1,
    )


def decayed_hll_estimate(registers: torch.Tensor, zero_rank: float = 0.5) -> torch.Tensor:
    """HyperLogLog estimate over fractional (time-decayed) ranks; () float32.

    As ``hll_estimate``, except that linear counting treats a register whose
    decayed rank fell below ``zero_rank`` as empty, so that the estimate
    decays toward 0 instead of flooring at ``alpha * m``.
    """
    m = registers.shape[0]
    alpha_m = {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1.0 + 1.079 / m))
    regs = registers.to(torch.float32)
    raw = alpha_m * m * m / torch.sum(_exp2_f32(-regs))
    zeros = torch.sum(regs < zero_rank).to(torch.float32)
    linear = m * torch.log(m / torch.clamp(zeros, min=1.0))
    est = torch.where((raw <= 2.5 * m) & (zeros > 0), linear, raw)
    two32 = 4294967296.0
    large = -two32 * torch.log(torch.clamp(1.0 - est / two32, min=1e-12))
    return torch.where(est > two32 / 30.0, large, est)
