"""Data helpers (counterpart of ``metrics_tpu/utils/data.py``)."""

from __future__ import annotations

from typing import List, Sequence, Union

import torch


def dim_zero_cat(x: Union[torch.Tensor, List[torch.Tensor]]) -> torch.Tensor:
    """Concatenation along the zero dimension."""
    if isinstance(x, torch.Tensor):
        return x
    x = [y if y.ndim else y.reshape(1) for y in x]
    if not x:
        raise ValueError("No samples to concatenate")
    return torch.cat(x, dim=0)


def dim_zero_sum(x: torch.Tensor) -> torch.Tensor:
    """Summation along the zero dimension."""
    return torch.sum(x, dim=0)


def dim_zero_mean(x: torch.Tensor) -> torch.Tensor:
    """Average along the zero dimension."""
    return torch.mean(x, dim=0)


def dim_zero_max(x: torch.Tensor) -> torch.Tensor:
    """Max along the zero dimension."""
    return torch.amax(x, dim=0)


def dim_zero_min(x: torch.Tensor) -> torch.Tensor:
    """Min along the zero dimension."""
    return torch.amin(x, dim=0)


def _flatten(x: Sequence) -> list:
    """Flatten a list of lists into one list."""
    return [item for sublist in x for item in sublist]


def to_onehot(label_tensor: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Dense labels ``(N, ...)`` to one-hot ``(N, C, ...)``.

    >>> to_onehot(torch.tensor([0, 1, 2]), num_classes=3)
    tensor([[1, 0, 0],
            [0, 1, 0],
            [0, 0, 1]])
    """
    classes = torch.arange(num_classes, device=label_tensor.device, dtype=label_tensor.dtype)
    classes = classes.reshape((1, num_classes) + (1,) * (label_tensor.ndim - 1))
    return (label_tensor.unsqueeze(1) == classes).long()


def _topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last dim, ties to the lower index.

    ``torch.topk`` does not fix the order of ties; a stable descending sort
    gives the order of ``jax.lax.top_k``.
    """
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def select_topk(prob_tensor: torch.Tensor, topk: int = 1, dim: int = 1) -> torch.Tensor:
    """One-hot mask of the top-k entries along ``dim``.

    >>> select_topk(torch.tensor([[1.1, 2.0, 3.0], [2.0, 1.0, 0.5]]), topk=2)
    tensor([[0, 1, 1],
            [1, 1, 0]])
    """
    moved = prob_tensor.movedim(dim, -1)
    idx = moved.argmax(dim=-1, keepdim=True) if topk == 1 else _topk_indices(moved, topk)
    mask = torch.zeros(moved.shape, dtype=torch.int64, device=prob_tensor.device).scatter_(-1, idx, 1)
    return mask.movedim(-1, dim)


def bincount(x: torch.Tensor, minlength: int) -> torch.Tensor:
    """Counts of each value in ``[0, minlength)``; larger values are dropped.

    >>> bincount(torch.tensor([0, 2, 2, 5]), minlength=6)
    tensor([1, 0, 2, 0, 0, 1])
    """
    return torch.bincount(x.reshape(-1), minlength=minlength)[:minlength]


def bincount_weighted(x: torch.Tensor, weights: torch.Tensor, minlength: int) -> torch.Tensor:
    """Sums of ``weights`` by the value of ``x`` in ``[0, minlength)``, in the weights' type.

    Every value of ``x`` must lie in ``[0, minlength)``. The sums are float sums:
    their order differs from the JAX package's, and on a CUDA device from one
    run to the next, so they agree to rounding, not bit for bit.

    >>> bincount_weighted(torch.tensor([0, 2, 2]), torch.tensor([0.5, 1.0, 2.0]), minlength=3)
    tensor([0.5000, 0.0000, 3.0000])
    """
    weights = weights.reshape(-1)
    out = torch.zeros(minlength, dtype=weights.dtype, device=weights.device)
    return out.index_add_(0, x.reshape(-1), weights)
