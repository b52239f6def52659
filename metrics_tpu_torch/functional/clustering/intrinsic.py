"""Embedding-based clustering metrics (counterpart of ``metrics_tpu/functional/clustering/intrinsic.py``).

The labels are compacted on their own device and the centroids are ``index_add_`` sums. The ``(K, K)``
centroid distances come from ``torch.cdist`` with the difference taken pair by pair (never the ``(K, K, d)``
tensor of the JAX package, and not the matrix-product expansion, whose rounding would differ from it).
"""

from __future__ import annotations

from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _is_traced
from metrics_tpu_torch.utils.exceptions import TraceIneligibleError
from metrics_tpu_torch.utils.compute import acc_dtype
from metrics_tpu_torch.utils.data import compact_labels


def _cluster_stats(data: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, int, torch.Tensor, torch.Tensor]:
    """(label codes, cluster count, per-cluster sample counts, centroids); the counts are in ``acc_dtype()``, as
    the JAX package's segment sum of ones is in its default float type."""
    if _is_traced(labels):
        raise TraceIneligibleError(
            "intrinsic clustering metrics derive the cluster count from the data"
            " on the host and cannot run under torch.func.vmap; call them eagerly."
        )
    g, k = compact_labels(labels)
    counts = torch.bincount(g, minlength=k).to(acc_dtype())
    sums = torch.zeros((k, data.shape[1]), dtype=data.dtype, device=data.device).index_add_(0, g, data)
    return g, k, counts, sums / counts[:, None]


def _centroid_distances(centroids: torch.Tensor, p: float = 2.0) -> torch.Tensor:
    """``(K, K)`` p-norm distances between centroids, each from its own difference vector."""
    return torch.cdist(centroids[None], centroids[None], p=p, compute_mode="donot_use_mm_for_euclid_dist")[0]


def calinski_harabasz_score(data: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Calinski-Harabasz score.

    >>> data = torch.tensor([[0., 0.], [0., 1.], [10., 10.], [10., 11.]])
    >>> calinski_harabasz_score(data, torch.tensor([0, 0, 1, 1]))
    tensor(400.)
    """
    data = data.to(torch.float32)
    g, k, counts, centroids = _cluster_stats(data, labels)
    n = data.shape[0]
    mean = data.mean(dim=0)
    between = torch.sum(counts * torch.sum((centroids - mean) ** 2, dim=1))
    within = torch.sum((data - centroids[g]) ** 2)
    safe_within = torch.where(within > 0, within, 1.0)
    return torch.where(within > 0, (between / safe_within) * ((n - k) / max(k - 1, 1)), 1.0)


def davies_bouldin_score(data: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Davies-Bouldin score.

    >>> data = torch.tensor([[0., 0.], [0., 1.], [10., 10.], [10., 11.]])
    >>> davies_bouldin_score(data, torch.tensor([0, 0, 1, 1]))
    tensor(0.0707)
    """
    data = data.to(torch.float32)
    g, k, counts, centroids = _cluster_stats(data, labels)
    to_centroid = torch.linalg.vector_norm(data - centroids[g], dim=1)
    intra = torch.zeros(k, dtype=to_centroid.dtype, device=data.device).index_add_(0, g, to_centroid) / counts
    cent_dist = _centroid_distances(centroids)
    ratio = (intra[:, None] + intra[None, :]) / torch.where(cent_dist > 0, cent_dist, torch.inf)
    ratio = torch.where(torch.eye(k, dtype=torch.bool, device=data.device), -torch.inf, ratio)
    return torch.mean(torch.amax(ratio, dim=1))


def dunn_index(data: torch.Tensor, labels: torch.Tensor, p: float = 2.0) -> torch.Tensor:
    """Dunn index: the least centroid distance over the largest distance of a sample to its centroid, both
    in the ``p``-norm.

    >>> data = torch.tensor([[0., 0.], [0., 1.], [10., 10.], [10., 11.]])
    >>> dunn_index(data, torch.tensor([0, 0, 1, 1]))
    tensor(28.2843)
    """
    data = data.to(torch.float32)
    g, k, counts, centroids = _cluster_stats(data, labels)
    cent_dist = _centroid_distances(centroids, p)
    inter = torch.amin(torch.where(torch.eye(k, dtype=torch.bool, device=data.device), torch.inf, cent_dist))
    intra = torch.amax(torch.linalg.vector_norm(data - centroids[g], ord=p, dim=-1))
    return inter / intra
