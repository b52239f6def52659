"""Reduction helpers and the cross-rank gather (counterpart of ``metrics_tpu/utils/distributed.py``).

The public reducers ``reduce`` and ``class_reduce``, and ``gather_all_states``
re-exported from :mod:`metrics_tpu_torch.parallel.sync`, so that code written
against the JAX package finds the same import surface. The re-export resolves
at first use: the sync layer imports the metric runtime, which imports this
package.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

__all__ = ["class_reduce", "gather_all_states", "reduce"]


def reduce(x: torch.Tensor, reduction: Optional[str]) -> torch.Tensor:
    """Reduce a tensor by name: ``elementwise_mean``, ``sum``, or ``none``/``None``.

    >>> reduce(torch.tensor([1.0, 2.0, 3.0]), "sum")
    tensor(6.)
    """
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "none" or reduction is None:
        return x
    if reduction == "sum":
        return torch.sum(x)
    raise ValueError("Reduction parameter unknown.")


def class_reduce(
    num: torch.Tensor, denom: torch.Tensor, weights: torch.Tensor, class_reduction: Optional[str] = "none"
) -> torch.Tensor:
    """Reduce the per-class fractions ``num / denom``.

    ``micro`` divides the totals, ``macro`` means the per-class fractions,
    ``weighted`` weighs them by ``weights``; a 0/0 class counts as 0, and x/0
    keeps its infinity.

    >>> tps = torch.tensor([1.0, 2.0, 0.0])
    >>> sup = torch.tensor([2.0, 2.0, 0.0])
    >>> class_reduce(tps, sup, sup, "macro")
    tensor(0.5000)
    """
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    if class_reduction == "micro":
        fraction = torch.sum(num) / torch.sum(denom)
    else:
        fraction = num / denom
    fraction = fraction.masked_fill(torch.isnan(fraction), 0.0)
    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights.to(fraction.dtype) / torch.sum(weights)))
    if class_reduction == "none" or class_reduction is None:
        return fraction
    raise ValueError(
        f"Reduction parameter {class_reduction} unknown. Choose between one of these: {valid_reduction}"
    )


def __getattr__(name: str) -> Any:
    if name == "gather_all_states":
        from metrics_tpu_torch.parallel.sync import gather_all_states

        return gather_all_states
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
