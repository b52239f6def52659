"""Pairwise functional metrics (counterpart of ``metrics_tpu/functional/pairwise/__init__.py``)."""

from metrics_tpu_torch.functional.pairwise.metrics import (
    pairwise_cosine_similarity,
    pairwise_euclidean_distance,
    pairwise_linear_similarity,
    pairwise_manhattan_distance,
    pairwise_minkowski_distance,
)

__all__ = [
    "pairwise_cosine_similarity",
    "pairwise_euclidean_distance",
    "pairwise_linear_similarity",
    "pairwise_manhattan_distance",
    "pairwise_minkowski_distance",
]
