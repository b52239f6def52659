"""Pairwise similarities and distances (counterpart of ``metrics_tpu/functional/pairwise/metrics.py``).

Cosine, linear and euclidean distances are one float32 matrix product each
(TF32 stays off, PyTorch's default); euclidean keeps the JAX package's
expansion ``|x|^2 + |y|^2 - 2 x y^T``, clamped at 0 before the root. The
manhattan and Minkowski distances take the JAX package's elementwise
arithmetic over blocks of rows of ``x``, so that no ``(N, M, d)`` tensor is
ever held whole (:func:`_distance_block_rows`).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

# one (rows, M, d) block holds the float32 differences and, for Minkowski, their powers
_BYTES_PER_ELEMENT = 8
_CPU_BLOCK_ELEMENTS = 1 << 24


def _check_input(
    x: torch.Tensor, y: Optional[torch.Tensor], zero_diagonal: Optional[bool]
) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {tuple(x.shape)}")
    if y is not None:
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                " `d` should be same as the last dimension of `x`"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x.to(torch.float32), y.to(torch.float32), zero_diagonal


def _reduce_distance_matrix(distmat: torch.Tensor, reduction: Optional[str] = None) -> torch.Tensor:
    """Final reduction of the distance matrix over its last dimension."""
    if reduction == "mean":
        return distmat.mean(dim=-1)
    if reduction == "sum":
        return distmat.sum(dim=-1)
    if reduction is None or reduction == "none":
        return distmat
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")


def _maybe_zero_diag(distmat: torch.Tensor, zero_diagonal: bool) -> torch.Tensor:
    if zero_diagonal:
        distmat.fill_diagonal_(0.0)
    return distmat


def _distance_block_rows(n: int, m: int, d: int, device: torch.device) -> int:
    """Rows of ``x`` per block: on a CUDA device, as many as keep a block within a quarter of the free memory;
    on the CPU, ``_CPU_BLOCK_ELEMENTS`` elements."""
    per_row = max(m * d, 1)
    if device.type != "cuda":
        return max(1, min(n, _CPU_BLOCK_ELEMENTS // per_row))
    free, _ = torch.cuda.mem_get_info(device)
    return int(max(1, min(n, free // 4 // (_BYTES_PER_ELEMENT * per_row))))


def _blocked_distance(x: torch.Tensor, y: torch.Tensor, exponent: Optional[Union[int, float]]) -> torch.Tensor:
    """``sum(|x_i - y_j|)`` (``exponent=None``) or ``sum(|x_i - y_j| ** p) ** (1 / p)`` for every pair, in
    blocks of rows of ``x``."""
    n, d = x.shape
    m = y.shape[0]
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    rows = _distance_block_rows(n, m, d, x.device)
    for start in range(0, n, rows):
        diff = (x[start:start + rows, None, :] - y[None, :, :]).abs_()
        if exponent is None:
            out[start:start + rows] = diff.sum(dim=-1)
        else:
            out[start:start + rows] = diff.pow_(exponent).sum(dim=-1) ** (1.0 / exponent)
    return out


def pairwise_cosine_similarity(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """Pairwise cosine similarity.

    >>> x = torch.tensor([[2., 3.], [3., 5.], [5., 8.]])
    >>> y = torch.tensor([[1., 0.], [2., 1.]])
    >>> pairwise_cosine_similarity(x, y)
    tensor([[0.5547, 0.8682],
            [0.5145, 0.8437],
            [0.5300, 0.8533]])
    """
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    norm_x = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    norm_y = torch.linalg.vector_norm(y, dim=1, keepdim=True)
    distmat = (x / norm_x.clamp(min=1e-12)) @ (y / norm_y.clamp(min=1e-12)).T
    distmat = _maybe_zero_diag(distmat, zero_diagonal)
    return _reduce_distance_matrix(distmat, reduction)


def pairwise_euclidean_distance(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """Pairwise euclidean distance through ``|x|^2 + |y|^2 - 2 x y^T``.

    >>> x = torch.tensor([[2., 3.], [3., 5.], [5., 8.]])
    >>> y = torch.tensor([[1., 0.], [2., 1.]])
    >>> pairwise_euclidean_distance(x, y)
    tensor([[3.1623, 2.0000],
            [5.3852, 4.1231],
            [8.9443, 7.6158]])
    """
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x_norm = torch.sum(x * x, dim=1, keepdim=True)
    y_norm = torch.sum(y * y, dim=1)
    distmat = x_norm + y_norm[None, :] - 2 * x @ y.T
    distmat = torch.sqrt(distmat.clamp_(min=0.0))
    distmat = _maybe_zero_diag(distmat, zero_diagonal)
    return _reduce_distance_matrix(distmat, reduction)


def pairwise_linear_similarity(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """Pairwise linear similarity ``x y^T``."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    distmat = x @ y.T
    distmat = _maybe_zero_diag(distmat, zero_diagonal)
    return _reduce_distance_matrix(distmat, reduction)


def pairwise_manhattan_distance(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """Pairwise manhattan distance, in blocks of rows of ``x``."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    distmat = _blocked_distance(x, y, None)
    distmat = _maybe_zero_diag(distmat, zero_diagonal)
    return _reduce_distance_matrix(distmat, reduction)


def pairwise_minkowski_distance(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    exponent: Union[int, float] = 2.0,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """Pairwise Minkowski distance of order ``exponent`` (at least 1), in blocks of rows of ``x``."""
    if not (isinstance(exponent, (float, int)) and exponent >= 1):
        raise ValueError(f"Argument ``exponent`` must be a float or int greater than 1, but got {exponent}")
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    distmat = _blocked_distance(x, y, exponent)
    distmat = _maybe_zero_diag(distmat, zero_diagonal)
    return _reduce_distance_matrix(distmat, reduction)
