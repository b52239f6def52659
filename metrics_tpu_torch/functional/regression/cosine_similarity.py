"""Cosine similarity (counterpart of ``metrics_tpu/functional/regression/cosine_similarity.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _cosine_similarity_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Validate a batch of ``(N, D)`` vectors, kept whole (float32) for the compute."""
    _check_same_shape(preds, target)
    if preds.ndim != 2:
        raise ValueError(
            "Expected input to cosine similarity to be 2D tensors of shape `[N,D]` where `N` is the number of "
            f"samples and `D` is the number of dimensions, but got tensor of shape {tuple(preds.shape)}"
        )
    return preds.to(torch.float32), target.to(torch.float32)


def _cosine_similarity_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Each row's cosine (0 for a zero vector: the norms' product is clamped below at epsilon), reduced."""
    dot_product = torch.sum(preds * target, dim=-1)
    norms = torch.linalg.vector_norm(preds, dim=-1) * torch.linalg.vector_norm(target, dim=-1)
    similarity = dot_product / torch.clamp(norms, min=torch.finfo(preds.dtype).eps)
    if reduction == "sum":
        return torch.sum(similarity)
    if reduction == "mean":
        return torch.mean(similarity)
    if reduction in ("none", None):
        return similarity
    raise KeyError(reduction)


def cosine_similarity(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Cosine similarity of each pair of rows, reduced by ``"sum"``, ``"mean"`` or ``"none"``.

    >>> target = torch.tensor([[1., 2., 3., 4.], [1., 2., 3., 4.]])
    >>> cosine_similarity(torch.tensor([[1., 2., 3., 4.], [-1., -2., -3., -4.]]), target, 'none')
    tensor([ 1., -1.])
    """
    preds, target = _cosine_similarity_update(preds, target)
    return _cosine_similarity_compute(preds, target, reduction)
