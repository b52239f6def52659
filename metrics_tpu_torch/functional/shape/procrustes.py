"""Procrustes disparity (counterpart of ``metrics_tpu/functional/shape/procrustes.py``): a batched
``torch.linalg.svd`` aligns each pair of point clouds."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def procrustes_disparity(
    point_cloud1: torch.Tensor, point_cloud2: torch.Tensor, return_all: bool = False
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Batched Procrustes analysis of ``(N, M, D)`` batches of M D-dimensional points: the per-batch disparity
    ``(N,)``, and with ``return_all`` the scale ``(N, 1)`` and rotation ``(N, D, D)`` too.

    A batch whose centred cloud is all zero (every point equal) has disparity 0, scale 1 and the identity
    rotation. Half-precision inputs are computed in float32.

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> pc1 = torch.from_numpy(rng.rand(1, 10, 3).astype(np.float32))
    >>> pc2 = torch.from_numpy(rng.rand(1, 10, 3).astype(np.float32))
    >>> round(float(procrustes_disparity(pc1, pc2)[0]), 4)
    0.7251
    """
    _check_same_shape(point_cloud1, point_cloud2)
    if point_cloud1.ndim != 3:
        raise ValueError(
            "Expected both datasets to be 3D tensors of shape (N, M, D), where N is the batch size, M is the number of"
            f" data points and D is the dimensionality of the data points, but got {point_cloud1.ndim} dimensions."
        )
    point_cloud1 = point_cloud1.to(torch.promote_types(point_cloud1.dtype, torch.float32))
    point_cloud2 = point_cloud2.to(torch.promote_types(point_cloud2.dtype, torch.float32))
    point_cloud1 = point_cloud1 - point_cloud1.mean(dim=1, keepdim=True)
    point_cloud2 = point_cloud2 - point_cloud2.mean(dim=1, keepdim=True)
    n1 = torch.linalg.vector_norm(point_cloud1, dim=(1, 2), keepdim=True)
    n2 = torch.linalg.vector_norm(point_cloud2, dim=(1, 2), keepdim=True)
    # a constant cloud would divide by zero and give the SVD NaNs: it is guarded batch by batch
    degenerate = ((n1 == 0) | (n2 == 0)).reshape(-1)
    point_cloud1 = point_cloud1 / torch.where(n1 == 0, 1.0, n1)
    point_cloud2 = point_cloud2 / torch.where(n2 == 0, 1.0, n2)

    u, w, vt = torch.linalg.svd(
        torch.matmul(point_cloud2.transpose(1, 2), point_cloud1).transpose(1, 2), full_matrices=False
    )
    rotation = torch.matmul(u, vt)
    scale = w.sum(dim=1, keepdim=True)
    point_cloud2 = scale[:, None] * torch.matmul(point_cloud2, rotation.transpose(1, 2))
    disparity = torch.where(degenerate, 0.0, ((point_cloud1 - point_cloud2) ** 2).sum(dim=(1, 2)))
    if return_all:
        eye = torch.eye(point_cloud1.shape[2], dtype=rotation.dtype, device=rotation.device).expand(rotation.shape)
        return (
            disparity,
            torch.where(degenerate[:, None], 1.0, scale),
            torch.where(degenerate[:, None, None], eye, rotation),
        )
    return disparity
