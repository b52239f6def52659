"""Critical success index (counterpart of ``metrics_tpu/functional/regression/csi.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.compute import _safe_divide

Tensor = torch.Tensor


def _critical_success_index_update(
    preds: Tensor, target: Tensor, threshold: float, keep_sequence_dim: Optional[int] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """Hits, misses and false alarms of ``value >= threshold`` (int64 counts).

    ``keep_sequence_dim`` is the index of the dimension to keep, or ``None`` to
    count over every dimension; a bool raises, since it would be read as
    dimension 0 or 1.
    """
    _check_same_shape(preds, target)
    if isinstance(keep_sequence_dim, bool) or (
        isinstance(keep_sequence_dim, torch.Tensor) and keep_sequence_dim.dtype == torch.bool
    ):
        raise ValueError(
            "`keep_sequence_dim` takes the index of the dimension to keep (or None), not a bool."
        )
    if keep_sequence_dim is None:
        sum_dims: Optional[Tuple[int, ...]] = None
    elif not 0 <= keep_sequence_dim < preds.ndim:
        raise ValueError(f"Expected keep_sequence dim to be in range [0, {preds.ndim}] but got {keep_sequence_dim}")
    else:
        sum_dims = tuple(i for i in range(preds.ndim) if i != keep_sequence_dim)
    preds_bin = preds >= threshold
    target_bin = target >= threshold
    counts = (preds_bin & target_bin, ~preds_bin & target_bin, preds_bin & ~target_bin)
    if sum_dims is None:
        return tuple(torch.sum(c) for c in counts)
    if not sum_dims:  # a 1-d input that keeps its only dimension: nothing to sum (torch reads () as every dim)
        return tuple(c.to(torch.int64) for c in counts)
    return tuple(torch.sum(c, dim=sum_dims) for c in counts)


def _critical_success_index_compute(hits: Tensor, misses: Tensor, false_alarms: Tensor) -> Tensor:
    """CSI = hits / (hits + misses + false alarms), 0 where nothing was observed or forecast."""
    return _safe_divide(hits, hits + misses + false_alarms)


def critical_success_index(
    preds: Tensor, target: Tensor, threshold: float, keep_sequence_dim: Optional[int] = None
) -> Tensor:
    """Critical success index at ``threshold``.

    >>> critical_success_index(torch.tensor([[0.2, 0.7], [0.9, 0.3]]), torch.tensor([[0.4, 0.2], [0.8, 0.6]]), 0.5)
    tensor(0.3333)
    """
    hits, misses, false_alarms = _critical_success_index_update(preds, target, threshold, keep_sequence_dim)
    return _critical_success_index_compute(hits, misses, false_alarms)
