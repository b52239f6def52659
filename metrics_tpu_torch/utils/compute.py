"""Numeric helpers (counterpart of ``metrics_tpu/utils/compute.py``)."""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch


def _safe_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y.T``."""
    return x @ y.T


def _safe_xlogy(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x * log(y)``, 0 wherever ``x == 0`` (whatever ``y`` is), as ``jax.scipy.special.xlogy``.

    >>> _safe_xlogy(torch.tensor([0.0, 2.0]), torch.tensor([0.0, 1.0]))
    tensor([0., 0.])
    """
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    zero = x == 0
    safe_y = torch.where(zero, torch.ones_like(y), y)
    return torch.where(zero, torch.zeros((), dtype=torch.result_type(x, y), device=x.device), x * torch.log(safe_y))


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    """``log(x)`` with ``x`` clamped below at the smallest normal number of its float type (float32 at least),
    so ``log(0)`` is a large negative finite value, not ``-inf``."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    return torch.log(torch.clamp(x.to(dtype), min=torch.finfo(dtype).tiny))


def count_dtype() -> torch.dtype:
    """The integer type of long-horizon counters: int64.

    The JAX package's ``count_dtype()`` is int64 under x64 and int32 under its
    default x32 regime; PyTorch always has int64, so the port's counters never
    wrap at 2^31, and ``_safe_divide`` maps int64 to the default float type.
    """
    return torch.int64


def acc_dtype() -> torch.dtype:
    """The float type of long-horizon accumulators: ``torch.get_default_dtype()``, float32 unless the caller
    chose float64, the counterpart of the JAX package's x32 default and its x64 switch."""
    return torch.get_default_dtype()


def log_factorial_table(n: int, device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """``log(k!)`` for ``k = 0..n + 1`` in float64 (``lgamma(k + 1)``), on ``device``.

    >>> log_factorial_table(3).exp()
    tensor([ 1.0000,  1.0000,  2.0000,  6.0000, 24.0000], dtype=torch.float64)
    """
    return torch.lgamma(torch.arange(n + 2, dtype=torch.float64, device=device) + 1)


def _flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """Float32 subnormals as zero (keeping their sign), as the JAX package's backends read them: XLA runs its CPU and
    TPU programs with subnormals flushed, so a comparison, a hash or a bin of such a value sees a zero."""
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny, x * 0.0, x)


def neumaier_add(total: torch.Tensor, comp: torch.Tensor, value: torch.Tensor) -> tuple:
    """One Neumaier (improved-Kahan) compensated accumulation step; returns the new ``(total, comp)``.

    The exact running sum is ``total + comp`` (:func:`neumaier_value`). Unlike
    classic Kahan this stays right when ``|value| > |total|``.
    """
    value = torch.as_tensor(value, device=total.device)
    t = total + value
    comp = comp + torch.where(total.abs() >= value.abs(), (total - t) + value, (value - t) + total)
    return t, comp


def neumaier_value(total: torch.Tensor, comp: torch.Tensor) -> torch.Tensor:
    """Read-out of a compensated pair: the corrected sum ``total + comp``."""
    return total + comp


def _safe_divide(num, denom, zero_division: float = 0.0) -> torch.Tensor:
    """Element-wise division with pinned zero-denominator semantics.

    Same contract as the JAX package (``metrics_tpu/utils/compute.py:70-103``):

    * ``x / 0 -> zero_division`` for every ``x``, including ``0 / 0``;
    * the masked lane divides by 1, so gradients through it stay finite;
    * the result type is the promotion of float32, the float operands' types
      and, for each int64 operand, ``torch.get_default_dtype()``: float32 for
      counters unless the user set float64, the counterpart of the JAX
      package's x32 default and its x64 switch. Narrower integer and bool
      operands count as float32, as they do in the JAX package under x64 too
      (its binned counts are int32 there, its counter states int64).

    Integer and bool operands are divided in float64, so int64 counters are
    never rounded before the division; the quotient of two exact integers,
    rounded once to float32, is the correctly rounded float32 quotient
    (53 >= 2 * 24 + 2), so below 2^24 it is bit-equal to the JAX package's
    float32 division.

    >>> _safe_divide(torch.tensor([1.0, 2.0]), torch.tensor([2.0, 0.0]))
    tensor([0.5000, 0.0000])
    >>> _safe_divide(torch.tensor([1, 2]), torch.tensor([3, 0])).dtype
    torch.float32
    """
    num = torch.as_tensor(num)
    denom = torch.as_tensor(denom, device=num.device)
    out_dtype = torch.float32
    for operand in (num, denom):
        if operand.dtype.is_floating_point:
            kind = operand.dtype
        else:
            kind = torch.get_default_dtype() if operand.dtype == torch.int64 else torch.float32
        out_dtype = torch.promote_types(out_dtype, kind)
    work = out_dtype
    if not (num.dtype.is_floating_point and denom.dtype.is_floating_point):
        work = torch.promote_types(out_dtype, torch.float64)
    num = num.to(work)
    denom = denom.to(work)
    zero_mask = denom == 0
    safe_denom = torch.where(zero_mask, torch.ones((), dtype=work, device=denom.device), denom)
    quotient = torch.where(zero_mask, torch.tensor(zero_division, dtype=work, device=denom.device), num / safe_denom)
    return quotient.to(out_dtype)


def _adjust_weights_safe_divide(
    score: torch.Tensor,
    average: Optional[str],
    multilabel: bool,
    tp: torch.Tensor,
    fp: torch.Tensor,
    fn: torch.Tensor,
    top_k: int = 1,
) -> torch.Tensor:
    """Apply micro/macro/weighted averaging to per-class scores."""
    if average is None or average == "none":
        return score
    if average == "weighted":
        weights = tp + fn
    else:
        weights = torch.ones_like(score)
        if not multilabel:
            present = ((tp + fp + fn) > 0) if top_k == 1 else ((tp + fn) > 0)
            weights = weights * present
    return _safe_divide(weights * score, weights.sum(dim=-1, keepdim=True)).sum(-1)


def _auc_compute_without_check(x: torch.Tensor, y: torch.Tensor, direction: float, axis: int = -1) -> torch.Tensor:
    """Trapezoidal area under ``y(x)`` along ``axis``, summed in the operands' type, for monotone ``x``."""
    dx = torch.diff(x, dim=axis)
    n = y.shape[axis]
    y_avg = (y.narrow(axis, 1, n - 1) + y.narrow(axis, 0, n - 1)) / 2.0
    return torch.sum(dx * y_avg, dim=axis) * direction


def _auc_compute(x: torch.Tensor, y: torch.Tensor, reorder: bool = False) -> torch.Tensor:
    """Trapezoidal area, optionally after sorting by ``x``; the sign follows the direction of ``x``.

    The JAX package takes the direction from the sign of the whole span of
    ``x`` (``x[-1] >= x[0]``) rather than checking that ``x`` is monotone; so
    does the port.
    """
    if reorder:
        order = torch.argsort(x, stable=True)
        x, y = x[order], y[order]
    area = _auc_compute_without_check(x, y, 1.0)
    return area * torch.where(x[-1] >= x[0], 1.0, -1.0).to(area.dtype)


def auc(x: torch.Tensor, y: torch.Tensor, reorder: bool = False) -> torch.Tensor:
    """Area under the curve ``y(x)`` by the trapezoidal rule.

    >>> auc(torch.tensor([0.0, 0.5, 1.0]), torch.tensor([0.0, 1.0, 1.0]))
    tensor(0.7500)
    """
    return _auc_compute(x, y, reorder=reorder)


def _searchsorted_right(sorted_arr: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """``jnp.searchsorted(sorted_arr, query, side="right")`` step for step.

    JAX runs a fixed number of bisection levels (``_searchsorted_via_scan``).
    On an array that is not sorted, which :func:`interp` is given by the macro
    precision-recall curve, the answer depends on those exact steps, so they
    are repeated here rather than left to ``torch.searchsorted``.
    """
    n = sorted_arr.shape[0]
    low = torch.zeros(query.shape, dtype=torch.int64, device=query.device)
    high = torch.full(query.shape, n, dtype=torch.int64, device=query.device)
    for _ in range(int(math.ceil(math.log2(n + 1)))):
        mid = (low + high) // 2
        go_left = query < sorted_arr[mid]
        low = torch.where(go_left, low, mid)
        high = torch.where(go_left, mid, high)
    return high


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """One-dimensional linear interpolation with ``jnp.interp``'s arithmetic."""
    dtype = torch.promote_types(torch.promote_types(x.dtype, xp.dtype), torch.float32)
    x, xp = x.to(dtype), xp.to(dtype)
    fp = fp.to(torch.promote_types(fp.dtype, torch.float32))
    i = _searchsorted_right(xp, x).clamp(1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(torch.finfo(dtype).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def normalize_logits_if_needed(tensor: torch.Tensor, normalization: str) -> torch.Tensor:
    """Sigmoid/softmax the input iff its values fall outside [0, 1].

    The test is on the min and max of the whole tensor, kept on the device:
    ``torch.where`` on a 0-d predicate picks the branch with no host read.

    >>> normalize_logits_if_needed(torch.tensor([0.1, 0.5, 0.9]), "sigmoid")
    tensor([0.1000, 0.5000, 0.9000])
    """
    if normalization not in ("sigmoid", "softmax"):
        raise ValueError(f"Unknown normalization: {normalization}")
    out_of_bounds = (tensor.min() < 0) | (tensor.max() > 1)
    normed = torch.sigmoid(tensor) if normalization == "sigmoid" else torch.softmax(tensor, dim=-1)
    return torch.where(out_of_bounds, normed, tensor)
