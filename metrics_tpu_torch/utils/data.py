"""Data helpers (counterpart of ``metrics_tpu/utils/data.py``)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _is_traced
from metrics_tpu_torch.utils.compute import interp  # noqa: F401  (the JAX package defines it in this module)


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


def _mean_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type of a mean: a float type keeps its own; int64 takes ``torch.get_default_dtype()``, any
    narrower integer or bool float32, as ``jnp.mean`` gives for int64 under x64 and int32 either way."""
    if dtype.is_floating_point:
        return dtype
    return torch.get_default_dtype() if dtype == torch.int64 else torch.float32


def dim_zero_mean(x: torch.Tensor) -> torch.Tensor:
    """Average along the zero dimension; integer states average to a float (:func:`_mean_dtype`)."""
    return torch.mean(x.to(_mean_dtype(x.dtype)), dim=0)


def dim_zero_max(x: torch.Tensor) -> torch.Tensor:
    """Max along the zero dimension."""
    return torch.amax(x, dim=0)


def dim_zero_min(x: torch.Tensor) -> torch.Tensor:
    """Min along the zero dimension."""
    return torch.amin(x, dim=0)


def _flatten(x: Sequence) -> list:
    """Flatten a list of lists into one list."""
    return [item for sublist in x for item in sublist]


def _flatten_dict(x: Dict) -> Tuple[Dict, bool]:
    """Flatten a dict of dicts into one dict; returns ``(flat, duplicates_found)``."""
    new_dict: Dict = {}
    duplicates = False
    for key, value in x.items():
        if isinstance(value, dict):
            for k, v in value.items():
                if k in new_dict:
                    duplicates = True
                new_dict[k] = v
        else:
            if key in new_dict:
                duplicates = True
            new_dict[key] = value
    return new_dict, duplicates


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
    zeros = torch.zeros(moved.shape, dtype=torch.int64, device=prob_tensor.device)
    mask = zeros.scatter(-1, idx, 1) if _is_traced(idx) else zeros.scatter_(-1, idx, 1)
    return mask.movedim(-1, dim)


def bincount(x: torch.Tensor, minlength: int) -> torch.Tensor:
    """Counts of each value in ``[0, minlength)``; larger values are dropped.

    >>> bincount(torch.tensor([0, 2, 2, 5]), minlength=6)
    tensor([1, 0, 2, 0, 0, 1])
    """
    if _is_traced(x):
        # torch.bincount has no batching rule (vmap would loop over the rows): the fixed-length scatter
        # gives the same counts, with the values outside [0, minlength) sent to a dropped bin
        x = x.reshape(-1)
        return bincount_fixed(torch.where((x >= 0) & (x < minlength), x, minlength), minlength + 1)[:minlength]
    return torch.bincount(x.reshape(-1), minlength=minlength)[:minlength]


def bincount_fixed(x: torch.Tensor, length: int) -> torch.Tensor:
    """int64 counts of each value of ``x`` in ``[0, length)``; every value must lie there.

    Unlike :func:`bincount` it never reads the data on the host: ``torch.bincount``
    reads the maximum back from a CUDA device to size its output, and this one
    adds into a tensor of the known size.

    >>> bincount_fixed(torch.tensor([0, 2, 2]), length=4)
    tensor([1, 0, 2, 0])
    """
    x = x.reshape(-1)
    ones = torch.ones(x.shape, dtype=torch.int64, device=x.device)
    zeros = torch.zeros(length, dtype=torch.int64, device=x.device)
    # under vmap the batched counts cannot be added into the unbatched zeros in place
    return zeros.index_add(0, x, ones) if _is_traced(x) else zeros.index_add_(0, x, ones)


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
    if _is_traced(x, weights):
        return out.index_add(0, x.reshape(-1), weights)
    return out.index_add_(0, x.reshape(-1), weights)


def to_categorical(x: torch.Tensor, argmax_dim: int = 1) -> torch.Tensor:
    """Probability-like scores to categorical labels: the arg-max along ``argmax_dim`` (the first of ties).

    >>> to_categorical(torch.tensor([[0.2, 0.5], [0.9, 0.1]]))
    tensor([1, 0])
    """
    return torch.argmax(x, dim=argmax_dim)


def allclose(tensor1: torch.Tensor, tensor2: torch.Tensor) -> bool:
    """``torch.allclose`` after casting ``tensor2`` to ``tensor1``'s type (rtol 1e-5, atol 1e-8, as
    ``jnp.allclose``).

    >>> allclose(torch.tensor([1.0, 2.0]), torch.tensor([1, 2]))
    True
    """
    if tensor1.dtype != tensor2.dtype:
        tensor2 = tensor2.to(tensor1.dtype)
    return bool(torch.allclose(tensor1, tensor2))


def compact_labels(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Map the values of ``x`` (flattened) to ``0..K-1`` in sorted order, on ``x``'s device, as ``np.unique``'s
    ``return_inverse`` does; returns the codes and ``K`` (one host read).

    >>> compact_labels(torch.tensor([7, 3, 7, 10]))
    (tensor([1, 0, 1, 2]), 3)
    """
    uniq, codes = torch.unique(x.reshape(-1), sorted=True, return_inverse=True)
    return codes, int(uniq.numel())
